"""The training protocol's model selection: the randomized CV search
(`parallel.tune`) and recursive feature elimination (`parallel.rfe`). Both
run their fits one after another on one device."""
