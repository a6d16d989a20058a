import sys

from kvazaar_tpu_torch.cli import main

sys.exit(main())
