from exposure_tpu_torch.utils.config import load_config
from exposure_tpu_torch.utils.dict_util import Dict, merge_dict
from exposure_tpu_torch.utils.ops import (
    STATE_DROPOUT_BEGIN,
    STATE_REWARD_DIM,
    STATE_STEP_DIM,
    STATE_STOPPED_DIM,
    lerp,
    lrelu,
    rgb2lum,
    tanh01,
    tanh_range,
)
