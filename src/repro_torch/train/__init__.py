"""LM training: the data pipeline, AdamW and the train step (a port of
``repro.train``; quarantined from the live tree like ``models``)."""
