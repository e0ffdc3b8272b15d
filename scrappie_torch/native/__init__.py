"""The port's C++ host loops (event detection, the dwell overlapper,
homopolymer runs), built with g++ at first use and bound with ctypes:
`build.py` builds, `bindings.py` wraps. Counterpart of
scrappie_tpu/native, without its fallback: a library that cannot be built
or loaded raises."""
