"""ID codecs: ROC (bits-back rANS) precision rules and the lane-batched torch
codec."""
