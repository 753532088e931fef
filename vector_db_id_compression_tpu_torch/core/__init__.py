"""Core primitives: the MT19937 initial-bits pool, the host rANS state
machine and the order statistics of the host ROC codec."""
