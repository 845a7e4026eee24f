"""Peaks of the card and the work counts of each roofline."""
