"""Configurations of the models the port serves (recsys so far)."""
