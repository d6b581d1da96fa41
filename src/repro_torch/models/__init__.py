"""The LM side of the port: layers, every model family (the transformer
with its MoE FFN, the RG-LRU hybrid, xLSTM, whisper) and the model zoo
(port of `repro.models`)."""
