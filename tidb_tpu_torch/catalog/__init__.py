"""Table schema objects (the ColumnInfo/TableInfo part of tidb_tpu/catalog)."""
