from .ref import rope_ref, rope_tables  # noqa: F401
from .kernel import KERNEL, rope_launch  # noqa: F401
from .ops import rope  # noqa: F401
