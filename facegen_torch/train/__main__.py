"""``python -m facegen_torch.train [facegen's train.py flags]``."""

import torch.distributed as dist

from facegen_torch.train import main

main()
if dist.is_initialized():  # launched as one of N ranks (parallel/multihost.py)
    dist.destroy_process_group()
