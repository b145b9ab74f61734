from .real_accelerator import get_accelerator  # noqa: F401
