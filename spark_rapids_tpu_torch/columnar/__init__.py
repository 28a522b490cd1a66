from .batch import (ColumnarBatch, batch_from_numpy, bucket_rows,
                    concat_batches)
from .column import Column, bucket_strlen

__all__ = ["Column", "ColumnarBatch", "batch_from_numpy", "bucket_rows",
           "bucket_strlen", "concat_batches"]
