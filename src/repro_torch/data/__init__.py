from repro_torch.data.fed_dataset import FedDataset
from repro_torch.data.synthetic import make_synthetic
from repro_torch.data.vision import make_cifar_like, make_fashion_like
from repro_torch.data.partition import (dirichlet_label_partition,
                                        two_label_partition, lognormal_sizes)
from repro_torch.data.lm_stream import token_batches
