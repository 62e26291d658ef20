"""Host C++ of the port, built at first use and loaded with ``ctypes``:
``framepack.cpp``, the multithreaded training-window assembler of
``data/packed.py`` (``build.load_framepack``)."""
