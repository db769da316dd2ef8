"""Native (C++) host runtime of the port, built with g++ on first use and
loaded with ctypes: the tar-shard index (tario.py).  The JAX package's
other native piece, the frame normalise / crop / resize, is numpy here
(ops/resize.py, data/video.py)."""
