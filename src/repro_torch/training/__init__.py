from repro_torch.training.optimizer import (AdamWConfig, adamw_init,  # noqa
                                            adamw_update, schedule)
from repro_torch.training.train import TrainState, make_train_step  # noqa
from repro_torch.training.data import synthetic_batches  # noqa
from repro_torch.training.checkpoint import (load_checkpoint,  # noqa
                                             save_checkpoint)
