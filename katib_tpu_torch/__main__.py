import sys

from katib_tpu_torch.cli import main

# guarded: importing every module of the package (the isolation test does)
# must not run the CLI
if __name__ == "__main__":
    sys.exit(main())
