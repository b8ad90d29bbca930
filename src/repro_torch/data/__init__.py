"""Token pipelines of the training plane."""
