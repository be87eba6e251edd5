"""Engine surface of the port (``BatonEngine``)."""
