# Step builders and input specs of the serving path (steps.py).
