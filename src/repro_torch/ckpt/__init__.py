from .checkpoint import (async_save, load_manifest, restore, save,  # noqa
                         wait_pending)
