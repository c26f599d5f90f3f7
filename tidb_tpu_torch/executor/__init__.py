"""Root-side executors of the port."""
