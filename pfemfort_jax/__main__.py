from pfemfort_jax.drivers.cli import main
import sys

sys.exit(main())
