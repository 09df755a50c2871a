"""Host data pipeline: discovery/pairing, augmentation, packed storage,
KITTI, and the host -> device prefetch. Port of
``fcn8s_tensorflow_tpu/data``, without OpenCV."""

from .generator import BatchGenerator, DataError
from .packed import PackedDataset, pack_dataset

__all__ = ["BatchGenerator", "DataError", "PackedDataset", "pack_dataset"]
