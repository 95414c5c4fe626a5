from esa_pose_estimation_tpu_torch.obs.logger import (  # noqa: F401
    JsonlLogger,
    TcpPusher,
    TsvLogger,
)
from esa_pose_estimation_tpu_torch.obs.tbevents import TbWriter  # noqa: F401
