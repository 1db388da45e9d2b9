"""Native (C++) components of the port: the token-corpus prefetch loader
(`dataloader.cpp`, bound with ctypes in `dataloader.py`), built at first
use into `build/torch_native/`."""
