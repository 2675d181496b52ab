"""Training substrate of the port: AdamW (``optimizer``)."""
