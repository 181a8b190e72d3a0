// Continuous-batching request scheduler with a C ABI (ctypes-consumed).
//
// The reference serves one request at a time: the REST handler takes a
// write lock on the whole Master for the duration of a generation
// (cake-core/src/cake/api/text.rs:67 — SURVEY.md §3.3). This scheduler
// replaces that global lock with slot-based continuous batching: requests
// queue FCFS, get admitted to free decode slots, and each engine
// iteration asks for a plan (who needs prefill, who decodes). Token
// reports retire requests on EOS / max-tokens and free their slot for the
// next queued request — admission happens between decode steps, not
// between requests.
//
// Thread-safe: the HTTP threads submit/cancel while the engine thread
// plans/reports. All state behind one mutex; calls are O(slots).

#include <cstdint>
#include <deque>
#include <mutex>
#include <unordered_map>
#include <vector>

namespace {

struct Request {
  uint64_t id;
  int32_t prompt_len;
  int32_t max_new_tokens;
  int32_t generated = 0;
  int32_t slot = -1;
  bool prefilled = false;
};

struct Sched {
  std::mutex mu;
  int32_t max_slots;
  int32_t max_queue;
  std::deque<uint64_t> queue;                   // waiting request ids
  std::unordered_map<uint64_t, Request> reqs;   // queued + active
  std::vector<uint64_t> slots;                  // slot -> req id (0 = free)
  int32_t active = 0;
  uint64_t completed = 0;

  explicit Sched(int32_t ns, int32_t nq) : max_slots(ns), max_queue(nq) {
    slots.assign(static_cast<size_t>(ns), 0);
  }
};

}  // namespace

extern "C" {

void* cake_sched_create(int32_t max_slots, int32_t max_queue) {
  if (max_slots <= 0 || max_queue < 0) return nullptr;
  return new Sched(max_slots, max_queue);
}

void cake_sched_destroy(void* h) { delete static_cast<Sched*>(h); }

// 0 = queued, -1 = queue full, -2 = duplicate/invalid id (0 is reserved)
int32_t cake_sched_submit(void* h, uint64_t id, int32_t prompt_len,
                          int32_t max_new_tokens) {
  Sched* s = static_cast<Sched*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  if (id == 0 || s->reqs.count(id)) return -2;
  if (static_cast<int32_t>(s->queue.size()) >= s->max_queue) return -1;
  Request r;
  r.id = id;
  r.prompt_len = prompt_len;
  r.max_new_tokens = max_new_tokens;
  s->reqs.emplace(id, r);
  s->queue.push_back(id);
  return 0;
}

// 0 = cancelled, -1 = unknown id
int32_t cake_sched_cancel(void* h, uint64_t id) {
  Sched* s = static_cast<Sched*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  auto it = s->reqs.find(id);
  if (it == s->reqs.end()) return -1;
  if (it->second.slot >= 0) {
    s->slots[static_cast<size_t>(it->second.slot)] = 0;
    --s->active;
  } else {
    for (auto q = s->queue.begin(); q != s->queue.end(); ++q) {
      if (*q == id) { s->queue.erase(q); break; }
    }
  }
  s->reqs.erase(it);
  return 0;
}

// Admit queued requests into free slots, then report the iteration plan.
// prefill_*: requests admitted this call (need their prompt run);
// decode_*: requests already prefilled (need one decode step).
// Arrays must hold >= max_slots entries. Returns total active.
int32_t cake_sched_plan(void* h, uint64_t* prefill_ids,
                        int32_t* prefill_slots, int32_t* n_prefill,
                        uint64_t* decode_ids, int32_t* decode_slots,
                        int32_t* n_decode) {
  Sched* s = static_cast<Sched*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  *n_prefill = 0;
  *n_decode = 0;
  // admission: FCFS into free slots
  for (int32_t slot = 0;
       slot < s->max_slots && !s->queue.empty(); ++slot) {
    if (s->slots[static_cast<size_t>(slot)] != 0) continue;
    uint64_t id = s->queue.front();
    s->queue.pop_front();
    Request& r = s->reqs[id];
    r.slot = slot;
    s->slots[static_cast<size_t>(slot)] = id;
    ++s->active;
    prefill_ids[*n_prefill] = id;
    prefill_slots[*n_prefill] = slot;
    ++(*n_prefill);
  }
  for (int32_t slot = 0; slot < s->max_slots; ++slot) {
    uint64_t id = s->slots[static_cast<size_t>(slot)];
    if (id == 0) continue;
    Request& r = s->reqs[id];
    if (r.prefilled) {
      decode_ids[*n_decode] = id;
      decode_slots[*n_decode] = slot;
      ++(*n_decode);
    }
    r.prefilled = true;  // after this plan, the engine has run its prefill
  }
  return s->active;
}

// Report n_tokens generated for a request; eos != 0 marks end-of-stream.
// Returns 1 if the request finished (slot freed), 0 if still active,
// -1 unknown id.
int32_t cake_sched_report(void* h, uint64_t id, int32_t n_tokens,
                          int32_t eos) {
  Sched* s = static_cast<Sched*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  auto it = s->reqs.find(id);
  if (it == s->reqs.end() || it->second.slot < 0) return -1;
  Request& r = it->second;
  r.generated += n_tokens;
  if (eos || r.generated >= r.max_new_tokens) {
    s->slots[static_cast<size_t>(r.slot)] = 0;
    --s->active;
    ++s->completed;
    s->reqs.erase(it);
    return 1;
  }
  return 0;
}

int32_t cake_sched_queue_depth(void* h) {
  Sched* s = static_cast<Sched*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  return static_cast<int32_t>(s->queue.size());
}

int32_t cake_sched_active(void* h) {
  Sched* s = static_cast<Sched*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  return s->active;
}

uint64_t cake_sched_completed(void* h) {
  Sched* s = static_cast<Sched*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  return s->completed;
}

}  // extern "C"
