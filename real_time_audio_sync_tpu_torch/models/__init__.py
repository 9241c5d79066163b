"""Alignment engines: the fused streaming OTW/LiveNote/LiveNoteV2 engine (``fused_streaming``) and their shared core (``online_core``)."""
