from . import lr_scheduler  # noqa: F401
from .lr_scheduler import build_schedule, build_scheduler  # noqa: F401
from .optimizers import Lion, adam, adamw, lion  # noqa: F401
