from .rl_module import (CNNRLModule, DefaultRLModule, RLModule,
                        params_from_flax)
from .learner import Learner, LearnerGroup
