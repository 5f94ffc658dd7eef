"""As device_step_ms.i2v.py, in the SVD-XT cell."""

import os
import runpy

read = runpy.run_path(os.path.join(os.path.dirname(__file__),
                                   "device_step_ms.i2v.py"))["read"]
