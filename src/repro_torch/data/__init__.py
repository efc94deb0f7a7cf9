"""Synthetic data -- counterpart of `repro.data`."""
from repro_torch.data.synthetic import (DataConfig, data_iterator,
                                        random_matrix, synth_batch)

__all__ = ["DataConfig", "synth_batch", "data_iterator", "random_matrix"]
