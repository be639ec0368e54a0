"""Architecture configs ported so far.  Importing this package registers
them into the registry (``repro_torch.config.get_arch``)."""

from repro_torch.configs import gemma3_12b  # noqa: F401
from repro_torch.configs import gemma_2b  # noqa: F401
from repro_torch.configs import mamba2_370m  # noqa: F401
from repro_torch.configs import musicgen_medium  # noqa: F401
from repro_torch.configs import olmoe_1b_7b  # noqa: F401
from repro_torch.configs import phi3_5_moe  # noqa: F401
from repro_torch.configs import qwen2_5_32b  # noqa: F401
from repro_torch.configs import qwen2_vl_72b  # noqa: F401
from repro_torch.configs import recurrentgemma_2b  # noqa: F401
from repro_torch.configs import stablelm_12b  # noqa: F401
