"""Launchers of the port (`repro.launch`): the end-to-end train loop."""
