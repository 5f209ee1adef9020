from repro_torch.data.fed_dataset import FedDataset
from repro_torch.data.synthetic import make_synthetic
