"""The model stack of the port: configs, layers, the dense decoder's
one-token decode, and carrying parameters across from host arrays."""
