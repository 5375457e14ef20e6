from .ref import rope_ref, rope_tables  # noqa: F401
