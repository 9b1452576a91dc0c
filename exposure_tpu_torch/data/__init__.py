from exposure_tpu_torch.data.provider import DataProvider
from exposure_tpu_torch.data.synthetic import (
    PairedSyntheticDataProvider,
    SyntheticDataProvider,
    make_paired_synthetic_pack,
    make_synthetic_pack,
)
