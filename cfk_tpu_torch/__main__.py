import sys

from cfk_tpu_torch.cli import main

sys.exit(main())
