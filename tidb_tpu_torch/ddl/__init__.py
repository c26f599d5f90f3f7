from .jobs import DDLJob

__all__ = ["DDLJob"]
