from progen_tpu_torch.data.dataset import iterator_from_tfrecords_folder
from progen_tpu_torch.data.tfrecord import read_tfrecords, tfrecord_writer
from progen_tpu_torch.data.tokenizer import (
    PAD_ID,
    decode_tokens,
    encode_tokens,
)

__all__ = [
    "PAD_ID",
    "encode_tokens",
    "decode_tokens",
    "read_tfrecords",
    "tfrecord_writer",
    "iterator_from_tfrecords_folder",
]
