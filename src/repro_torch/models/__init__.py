"""The LM side of the port: layers, the dense / vlm transformer and the
model zoo (port of `repro.models`; MoE, the recurrent families and
whisper are ROADMAP A12c and A12d)."""
