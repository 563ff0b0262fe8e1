"""``python -m facegen_torch.train [facegen's train.py flags]``."""

from facegen_torch.train import main

main()
