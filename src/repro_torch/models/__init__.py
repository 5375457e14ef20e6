from .api import MODES, Model, build_model  # noqa: F401
from .convert import params_from_numpy  # noqa: F401
