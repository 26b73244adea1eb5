"""Host utilities: ctypes bindings of the native host runtime
(`native/libgnss_native.so`, shared with the JAX package) with numpy
fallbacks."""
