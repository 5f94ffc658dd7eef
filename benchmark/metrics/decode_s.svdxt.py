"""As decode_s.py, in the SVD-XT cell."""

import os
import runpy

read = runpy.run_path(os.path.join(os.path.dirname(__file__),
                                   "decode_s.py"))["read"]
