from .api import (MODES, MadeBatches, Model, build_model,  # noqa: F401
                  make_batch)
from .convert import params_from_numpy  # noqa: F401
