from .state import init_state, sharded_init, state_shardings  # noqa: F401
from .trainer import (FailureInjector, SimulatedFailure,  # noqa: F401
                      StragglerWatchdog, TrainLoopResult, loss_and_grads,
                      make_train_step, pin_bucket_policies,
                      train_loop)
