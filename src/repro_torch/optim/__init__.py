from .adamw import (OptCfg, adamw_init, adamw_update,  # noqa: F401
                    cosine_lr, global_norm)
