"""Formats: csv, json, native binary, columnar, avro, parquet and protobuf
codecs between bytes or text and columnar ``RecordBatch``es (port of
``flink_tpu/formats/``). See ``formats/core.py``."""

from .core import BinaryFormat, CsvFormat, Format, JsonFormat

__all__ = ["Format", "CsvFormat", "JsonFormat", "BinaryFormat",
           "ParquetFormat", "ProtobufFormat"]


def __getattr__(name):
    # lazy: pyarrow and protobuf load only when a format is asked for
    if name == "ParquetFormat":
        from .parquet import ParquetFormat
        return ParquetFormat
    if name == "ProtobufFormat":
        from .protobuf import ProtobufFormat
        return ProtobufFormat
    raise AttributeError(name)
