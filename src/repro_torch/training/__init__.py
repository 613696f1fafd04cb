"""AdamW and the train-step builders (the port of ``repro.training``)."""
