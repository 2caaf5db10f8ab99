"""Architecture modules, one file an architecture: `<arch>.py`, found by
the name a configuration file gives under "arch" (`spec.arch`)."""
