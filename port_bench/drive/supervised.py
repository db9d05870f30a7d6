"""``cli/train.py --method fully_supervised``: ``Trainer`` over an
``EpochShuffleSampler``."""

from port_bench.drive.training import TrainingDriver
from port_bench.reference import data as ref_data


class Driver(TrainingDriver):
    def _trainer(self, model, train_cfg):
        from mamba_unet_torch.train import Trainer

        return Trainer(model, train_cfg, device=self.device)

    def _sampler(self, n: int):
        from mamba_unet_torch.data.sampler import EpochShuffleSampler

        return EpochShuffleSampler(n, self.traffic["batch_size"],
                                   seed=self.seed)

    def _ref_sampler(self, n: int):
        return ref_data.epoch_batches(n, self.traffic["batch_size"],
                                      self.seed)
