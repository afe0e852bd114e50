"""The IRC object detector."""
