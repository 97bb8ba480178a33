from .config import HelmholtzConfig                               # noqa: F401
