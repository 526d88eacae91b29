from .seamount import setup_seamount  # noqa: F401
from .rndtopo import setup_rndtopo    # noqa: F401
