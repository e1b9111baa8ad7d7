from . import log  # noqa: F401
from .log import Timer  # noqa: F401
