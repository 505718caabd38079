"""Native (C++) host-side tier: JPEG decode + preprocess (fastimage) and a
pipelined folder loader (fastloader).

The library is built with make at first use (never at import), into
``native/build/``; it needs a C++ compiler and the libjpeg headers.  Without
them ``is_available()`` is false and every entry point raises.
"""
