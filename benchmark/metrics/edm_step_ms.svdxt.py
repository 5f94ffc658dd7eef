"""As ddim_step_ms.py, in the SVD-XT cell."""

import os
import runpy

read = runpy.run_path(os.path.join(os.path.dirname(__file__),
                                   "ddim_step_ms.py"))["read"]
