"""`python -m gridpp_tpu_torch` runs the CLI client: on the card when
there is one (the client's calls take the module functions' card routes),
else on the CPU."""
import sys

from .client import main

sys.exit(main())
