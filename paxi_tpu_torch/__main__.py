import sys

from paxi_tpu_torch.cli import main

sys.exit(main())
