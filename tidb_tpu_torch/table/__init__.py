from .table import Table
