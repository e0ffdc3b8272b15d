import sys

from scrappie_torch.cli.main import main

sys.exit(main())
