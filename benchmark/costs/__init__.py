"""The yardstick's counts: each kernel's operations and bytes as a
function of its call's shapes (one module a kernel), each model's
operations per example and the kernel calls of its step (one module a
model), and the card's published peaks (`peaks.py`).  They read the
same work whatever implements it."""
