"""The training runtime: ``initialize`` → ``TorchEngine.train_batch``."""
