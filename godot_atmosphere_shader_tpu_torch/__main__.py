"""``python -m godot_atmosphere_shader_tpu_torch``: the command line of
:mod:`.cli`."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
