.PHONY: test bench docs docs-torch build up exec down

test:
	python -m pytest tests/ -q

bench:
	python bench.py

docs:
	python tools/build_docs.py

docs-torch:
	python -m ccvm_tpu_torch.tools.build_docs

build:
	docker compose -f docker/docker-compose.yaml build

up:
	docker compose -f docker/docker-compose.yaml up -d

exec:
	docker exec -it ccvm-tpu bash

down:
	docker compose -f docker/docker-compose.yaml down --remove-orphans
