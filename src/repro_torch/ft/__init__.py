"""The fault-tolerant training driver -- counterpart of `repro.ft`."""
