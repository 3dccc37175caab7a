"""The port's data pipeline: tabular regression sets for the profiling
predictors."""
from repro_torch.data.synthetic import TabularDataset, batch_indices, batches

__all__ = ["TabularDataset", "batch_indices", "batches"]
