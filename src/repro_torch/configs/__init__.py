from repro_torch.configs.base import (ArchConfig, MoEConfig, SSMConfig,  # noqa
                                     reduced)
from repro_torch.configs.registry import (ALL, ASSIGNED, PAPER_MODELS,  # noqa
                                         get_config)
