"""The fault-tolerant step loop and the straggler monitor: the port's
copies of ``repro/runtime/fault_tolerance.py`` and ``straggler.py``."""
