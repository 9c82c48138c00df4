"""Native (C++) host-path libraries, built at first use (bindings.py)."""
