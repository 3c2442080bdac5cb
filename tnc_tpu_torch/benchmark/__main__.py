import sys

from tnc_tpu_torch.benchmark.cli import main

sys.exit(main())
