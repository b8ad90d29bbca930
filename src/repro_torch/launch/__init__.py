"""The launch tools of the port: the serve and train launchers, the
meta-device dry-run with its op-level analysis, the roofline report and
the mesh layouts they plan for."""
