"""AdamW and int8 gradient compression (the reference's ``optim``)."""
from .adamw import (AdamWConfig, adamw_init, adamw_update,  # noqa: F401
                    cosine_schedule, global_norm)
from .compress import int8_compress, int8_decompress  # noqa: F401
