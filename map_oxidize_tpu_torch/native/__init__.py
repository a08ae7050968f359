"""The native C++ host map loop (tokenize + hash + in-chunk combine) and its
ctypes binding; built with ``g++`` at first use."""
