"""Interpolation models of the port: RIFE, GMFSS and GMFSS_UNION, each a
subclass of ``base.Model``, which holds the API they share and its routing
through the captured graphs."""
