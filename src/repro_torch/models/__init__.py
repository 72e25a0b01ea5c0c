"""Models the port serves: DeepFM (``recsys``)."""
