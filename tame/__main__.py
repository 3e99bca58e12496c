"""``python -m tame`` entry point."""

import sys

from tame.cli import main
from tame.utils.cache import enable_compile_cache

enable_compile_cache()
sys.exit(main())
