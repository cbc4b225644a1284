"""Jobs, one module a kind of work a cell drives, found by the name its
traffic file gives.  A module's ``Job(config, traffic, device)`` makes
the inputs (through the generator the traffic names), runs one unit of
the timed work (``fit``), and compares a sample of the window's outputs
with the plain reference (``check``)."""
