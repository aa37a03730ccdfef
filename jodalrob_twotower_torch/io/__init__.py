"""TFRecord IO of the port (port of ``jodalrob_twotower_tpu/io/``)."""

from jodalrob_twotower_torch.io.tfrecord import (  # noqa: F401
    TFRecordReader,
    TFRecordWriter,
    count_records,
    decode_example,
    encode_example,
    inspect_tfrecord,
    search_records,
    table_to_tfrecord,
)
