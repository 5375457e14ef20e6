from .pipeline import (DataConfig, DataIterator, batch_at,  # noqa: F401
                       batch_rows)
