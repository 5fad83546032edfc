from .batch import (  # noqa: F401
    DIFF_DTYPE,
    MAX_DEVICE_TIME,
    PAD_TIME,
    UpdateBatch,
    bucket_cap,
    device_time_scalar,
    to_device_time,
)
from .hashing import PAD_HASH, hash_columns, mix_columns, value_view  # noqa: F401
