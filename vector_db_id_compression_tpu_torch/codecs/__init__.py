"""ID codecs: ROC (bits-back rANS) precision rules, the host codec, the
lane-batched torch codec and interleaved ROC."""
