"""File I/O of the port: a Parquet reader that needs no pyarrow (footer
and page headers in io/thrift.py and io/parquet_meta.py, chunk decode in
io/host_decode.py over the g++ library csrc/parquet_host.cpp), the
reader strategies of io/file_scan.py, and the opt-in raw ingest of
io/device_decode.py."""
from .file_scan import FileScanBase, apply_path_rules, expand_paths
from .parquet import ParquetScanExec, parquet_files
from .parquet_meta import parquet_schema, read_footer

__all__ = ["FileScanBase", "ParquetScanExec", "apply_path_rules",
           "expand_paths", "parquet_files", "parquet_schema", "read_footer"]
