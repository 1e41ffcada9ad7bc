"""step2d-brm2-l4: fenapack's backward-facing step demo at the demo's own
level through the port's main path: the build of ``step2d-brm2-l2.py``,
which reads the level and the solver settings from the file."""
import os

from pcdbench.run import load_module

_STEP2D = load_module(os.path.join(os.path.dirname(os.path.abspath(
    __file__)), "step2d-brm2-l2.py"), "pcdbench_config_step2d_brm2_l2")
target, lower_precision = _STEP2D.target, _STEP2D.lower_precision
