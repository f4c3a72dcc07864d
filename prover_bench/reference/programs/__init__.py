"""Cairo programs the reference can state a run of: each module gives
`bytecode(n)`, the program at size n."""
