"""The C++ npz batch loader (``npz_loader.cpp``), bound with ctypes."""
from pacingpseudo_torch.data.native.loader import (NativeBatchLoader, build_error,
                                                   load_batch_native, native_available)

__all__ = ["NativeBatchLoader", "build_error", "load_batch_native", "native_available"]
