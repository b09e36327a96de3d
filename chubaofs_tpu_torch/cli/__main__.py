import sys

from chubaofs_tpu_torch.cli.main import main

sys.exit(main())
