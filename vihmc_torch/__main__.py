import sys

from vihmc_torch.pipelines.cli import main

if __name__ == "__main__":
    sys.exit(main())
