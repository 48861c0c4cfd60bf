import sys

from .pipeline.cli import main

sys.exit(main())
