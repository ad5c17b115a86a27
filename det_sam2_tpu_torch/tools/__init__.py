"""Offline tools: semi-supervised VOS inference, the J&F benchmark, SA-V
dataset browsing, frame extraction and detector-label refinement."""
