"""The data path of the port (deepsee_tpu/data/): the native codec
(`codec`), the transforms, the datasets, the threaded loader, and the copy
of host batches to the card (`device`)."""

from deepsee_torch.data.datasets import (
    CelebADataset,
    CelebAMaskHQDataset,
    SkipSampleException,
    SyntheticDataset,
    create_dataset,
)
from deepsee_torch.data.device import DevicePrefetcher, to_device
from deepsee_torch.data.loader import DataLoader
from deepsee_torch.data.transforms import (
    TransformParams,
    apply_image_transform,
    apply_label_transform,
    get_params,
    load_image,
    load_label,
)
