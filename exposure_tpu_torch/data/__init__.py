from exposure_tpu_torch.data.provider import DataProvider
from exposure_tpu_torch.data.fivek import FiveKDataProvider
from exposure_tpu_torch.data.artist import ArtistDataProvider
from exposure_tpu_torch.data.folder import FolderDataProvider
from exposure_tpu_torch.data.folds import read_set
from exposure_tpu_torch.data.synthetic import (
    PairedSyntheticDataProvider,
    SyntheticDataProvider,
    make_paired_synthetic_pack,
    make_synthetic_pack,
)
