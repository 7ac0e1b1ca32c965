import sys

from fem_tpu_torch.cli import main

sys.exit(main())
